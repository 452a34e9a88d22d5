"""The fluid path's data parallelism in the port against the JAX package
on its 8-device CPU mesh: `CompiledProgram.with_data_parallel` (and
`ParallelExecutor`) on 8 in-process CPU ranks, `SPMDRunner` with the
`GradAllReduce` and `LocalSGD` transpilers, the 17 `c_*` ops, the five
ops the slice's modules emit, the fleet facade, the top-level fluid
conveniences, the refusals and the telemetry rows; rule (d), the
gather, on an op of each kind no cheaper rule takes (and on phase 28
(e)'s program); then the op library core's rules: the book's VGG-16-BN
with sync batch norm on 2 and 4 ranks, and a program around each new
row rule on 4.

Initial persistables come from the JAX scope (`convert.scope_from_numpy`),
feeds from a numpy seed. Tolerances: the loss at rtol 1e-5; a gradient,
a parameter or a batched fetch within 1e-5 of its tensor's largest
value (`_close`), plus under Adam what the step's gradient difference
can move its update (`chip_smoke.fluid_adam_slack`). The `CompiledProgram`
runs are resynced from the JAX scope every step, as
`test_torch_fluid_program.py::test_three_steps_match_jax` is; the
`SPMDRunner` runs are resynced too, except LocalSGD's, whose ranks hold
diverged params between averages (a resync would hand every rank rank
0's), so it runs free for its 4 steps.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as pt
import paddle_tpu.parallel as jpar
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.ir import OpDesc as JOpDesc
from paddle_tpu.observability import telemetry as jtel
from paddle_tpu.parallel.collective import GradAllReduce as JGradAllReduce
from paddle_tpu.parallel.collective import LocalSGD as JLocalSGD

import paddle_tpu_torch as ptt
import paddle_tpu_torch.parallel as tpar
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc
from paddle_tpu_torch.observability import perfwatch as tperf
from paddle_tpu_torch.observability import telemetry as ttel
from paddle_tpu_torch.parallel.collective import GradAllReduce, LocalSGD

torch.set_num_threads(2)

RANKS = 8
LOSS_RTOL = 1e-5
REL = 1e-5


def _close(got, want, what, slack=0.0):
    """Within REL of the reference's largest value (1 at least for a
    param under `slack`), beyond `slack`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want) - slack
    scale = np.abs(want).max() if want.size else 1.0
    if np.ndim(slack):
        scale = max(1.0, scale)
    assert err.max(initial=0.0) <= REL * scale, (what, float(err.max()))


def _mlp(pkg, seed=7):
    """`tests/test_parallel_executor.py`'s MLP (16 -> 32 relu -> 1), SGD 0.1."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=32, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [loss], pred


def _lenet(pkg):
    """`bench.py`'s LeNet rung (chip_smoke.py's copy), Adam 2e-3."""
    main, startup, loss = chip_smoke.lenet_rung_program(pkg)
    return main, startup, [loss], None


def _sum_loss(pkg):
    """A classifier whose loss is the batch's summed cross entropy
    (`reduce_sum`, not `mean`), with an `accuracy` fetch; SGD 1e-3."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[12], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(input=x, size=24, act="tanh")
        logits = pkg.layers.fc(input=h, size=5)
        loss = pkg.layers.reduce_sum(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        acc = pkg.layers.accuracy(input=logits, label=y)
        pkg.optimizer.SGD(learning_rate=1e-3).minimize(loss)
    return main, startup, [loss, acc], None


def _feed(name, rng, bs):
    if name == "mlp":
        x = rng.rand(bs, 16).astype("float32")
        return {"x": x, "y": (x @ rng.rand(16, 1)).astype("float32")}
    if name == "lenet":
        return {"x": rng.rand(bs, 1, 28, 28).astype("float32"),
                "y": rng.randint(0, 10, (bs, 1)).astype("int64")}
    return {"x": rng.standard_normal((bs, 12)).astype("float32"),
            "y": rng.randint(0, 5, (bs, 1)).astype("int64")}


PROGRAMS = {"mlp": (_mlp, 10, 64, None), "lenet": (_lenet, 3, 16, 2e-3),
            "sum_loss": (_sum_loss, 3, 32, None)}


def _build(name, pkg):
    return PROGRAMS[name][0](pkg)


def _pair(name):
    """(JAX program and fetches, the port's, the JAX scope after startup,
    an empty port scope, the persistables' names)"""
    jmain, jstart, jf, _ = _build(name, pt)
    tmain, tstart, tf, _ = _build(name, ptt)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jstart, scope=scj)
    pers = [v.name for v in jstart.list_vars() if v.persistable]
    return (jmain, jf), (tmain, tf), scj, ptt.Scope(), pers


def _resync(sct, scj, pers):
    scope_from_numpy(sct, {n: scj.get(n) for n in pers}, ptt.CPUPlace())


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compiled_program_matches_jax(name):
    """CompiledProgram on 8 CPU ranks against the JAX package's
    on its 8-device mesh, every step from the JAX state: the losses (and
    the accuracy), every parameter gradient and the updated params."""
    _, steps, bs, adam_lr = PROGRAMS[name]
    (jmain, jf), (tmain, tf), scj, sct, pers = _pair(name)
    params = [p.name for p in jmain.all_parameters()]
    fetch = [v.name for v in jf] + [p + "@GRAD" for p in params]
    cj = pt.CompiledProgram(jmain).with_data_parallel(loss_name=jf[0].name)
    ct = ptt.CompiledProgram(tmain).with_data_parallel(
        loss_name=tf[0].name, places=ptt.cpu_places(RANKS))
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(0)
    for step in range(steps):
        feed = _feed(name, rng, bs)
        _resync(sct, scj, pers)
        want = exej.run(cj, feed=feed, fetch_list=fetch, scope=scj)
        got = exet.run(ct, feed=feed, fetch_list=fetch, scope=sct)
        for a, b in zip(got[:len(jf)], want[:len(jf)]):
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
        for n, a, b in zip(params, got[len(jf):], want[len(jf):]):
            _close(a, b, f"{n}@GRAD step {step + 1}")
            slack = chip_smoke.fluid_adam_slack(adam_lr, a, b) \
                if adam_lr else 0.0
            _close(sct.get(n), scj.get(n), f"{n} step {step + 1}", slack)
    sstep = next(iter(ct._cache.values()))
    assert sstep.ring.size == RANKS
    assert sstep.rank_feed_shapes["x"][0] == bs // RANKS


def _dropout_mlp(impl):
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 5
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[16], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="float32")
        h = ptt.layers.dropout(ptt.layers.fc(input=x, size=32, act="relu"),
                               0.4, dropout_implementation=impl)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(
            input=ptt.layers.fc(input=h, size=1), label=y))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_drops_what_the_whole_batch_drops(impl):
    """Under CompiledProgram each rank takes its rows of the whole
    batch's mask (the JAX package's GSPMD step draws it over the whole
    batch), so 4 steps on 8 ranks equal one Executor's 4 steps on the
    whole batch from the same state and rng: the losses within
    LOSS_RTOL, the params within REL of their largest value."""
    main, startup, loss = _dropout_mlp(impl)
    exe = ptt.Executor(ptt.CPUPlace())
    scopes = [ptt.Scope(), ptt.Scope()]
    for sc in scopes:
        exe.run(startup, scope=sc)
    prog = ptt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=ptt.cpu_places(RANKS))
    params = [p.name for p in main.all_parameters()]
    rng = np.random.RandomState(4)
    for step in range(4):
        feed = _feed("mlp", rng, 64)
        want = exe.run(main, feed=feed, fetch_list=[loss], scope=scopes[0])
        got = exe.run(prog, feed=feed, fetch_list=[loss], scope=scopes[1])
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        for n in params:
            _close(scopes[1].get(n), scopes[0].get(n), f"{n} step {step}")


def test_sum_loss_gradients_are_the_global_sums():
    """With a summed loss, the ranks' gradients are the whole
    batch's sum (lockstep's rules (a)-(c)); averaging per-rank gradients, as a
    per-rank run would, is 8x off."""
    (jmain, jf), (tmain, tf), scj, sct, pers = _pair("sum_loss")
    params = [p.name for p in tmain.all_parameters()]
    feed = _feed("sum_loss", np.random.RandomState(1), 32)
    grads = [p + "@GRAD" for p in params]
    ct = ptt.CompiledProgram(tmain).with_data_parallel(
        places=ptt.cpu_places(RANKS))
    exe = ptt.Executor(ptt.CPUPlace())
    _resync(sct, scj, pers)
    whole = exe.run(ct, feed=feed, fetch_list=grads, scope=sct)
    per_rank = []
    for r in range(RANKS):
        _resync(sct, scj, pers)
        shard = {k: v[r * 4:(r + 1) * 4] for k, v in feed.items()}
        per_rank.append(exe.run(tmain, feed=shard, fetch_list=grads,
                                scope=sct))
    for i, n in enumerate(params):
        mean = np.mean([g[i] for g in per_rank], axis=0)
        _close(whole[i], RANKS * mean, n)
        assert np.abs(whole[i] - mean).max() > 0.5 * np.abs(whole[i]).max()


def _reduce_program(pkg, op, dim):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[3], dtype="float32")
        w = pkg.layers.create_parameter([3], "float32", name="w")
        y = pkg.layers.elementwise_mul(x, w)
        r = pkg.layers.mean(y) if op == "mean" else \
            getattr(pkg.layers, op)(y, dim=dim)
        grads = pkg.gradients([pkg.layers.reduce_sum(r)], [w])
    return main, startup, [r] + grads


@pytest.mark.parametrize("op, dim", [
    ("mean", None), ("reduce_sum", 0), ("reduce_sum", 1),
    ("reduce_mean", None), ("reduce_max", 0), ("reduce_min", [0, 1]),
    ("reduce_prod", 0)])
def test_batch_reductions_match_jax(op, dim):
    """Lockstep's rules (a) and (b) for every reduction over the batch dim (a
    reduction over dim 1 acts on each row): the reduced value and the
    weight gradient under CompiledProgram on 8 ranks against the JAX
    package's. reduce_max and reduce_min see ties across ranks (integer
    inputs), whose gradient goes evenly to every tie, as jax's does."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 3, (16, 3)) if op in ("reduce_max", "reduce_min") \
        else rng.uniform(0.8, 1.2, (16, 3))
    feed = {"x": x.astype("float32")}
    jmain, jstart, jf = _reduce_program(pt, op, dim)
    tmain, tstart, tf = _reduce_program(ptt, op, dim)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    scj = pt.Scope()
    exej = pt.Executor(pt.CPUPlace())
    exej.run(jstart, scope=scj)
    sct = scope_from_numpy(ptt.Scope(), {"w": scj.get("w")}, ptt.CPUPlace())
    want = exej.run(pt.CompiledProgram(jmain).with_data_parallel(),
                    feed=feed, fetch_list=jf, scope=scj)
    got = ptt.Executor(ptt.CPUPlace()).run(
        ptt.CompiledProgram(tmain).with_data_parallel(
            places=ptt.cpu_places(RANKS)), feed=feed, fetch_list=tf,
        scope=sct)
    for what, a, b in zip(("reduced", "w@GRAD"), got, want):
        _close(a, b, f"{op} {what}")


def _spmd_pair(kind):
    jmain, jstart, jf, jpred = _mlp(pt, seed=5)
    tmain, tstart, tf, tpred = _mlp(ptt, seed=5)
    for pkg, main, start, cls in ((pt, jmain, jstart, (JGradAllReduce,
                                                       JLocalSGD)),
                                  (ptt, tmain, tstart, (GradAllReduce,
                                                        LocalSGD))):
        with pkg.framework.unique_name.guard(), \
                pkg.program_guard(main, start):
            (cls[0](nranks=RANKS) if kind == "grad_allreduce" else
             cls[1](nranks=RANKS, k_steps=2)).transpile(main, start)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jstart, scope=scj)
    pers = [v.name for v in jstart.list_vars() if v.persistable]
    rj = jpar.SPMDRunner(jmain, jpar.make_mesh(jpar.MeshConfig(dp=RANKS),
                                               devices=jax.devices()))
    rt = tpar.SPMDRunner(tmain, tpar.make_mesh(tpar.MeshConfig(dp=RANKS),
                                               devices=["cpu"] * RANKS))
    return (jmain, rj, [jf[0], jpred]), (tmain, rt, [tf[0], tpred]), \
        scj, pers


@pytest.mark.parametrize("kind, steps", [("grad_allreduce", 5),
                                         ("local_sgd", 4)])
def test_spmd_runner_matches_jax(kind, steps):
    """SPMDRunner over 8 ranks against the JAX runner: the
    scalar loss (averaged over ranks), the batched prediction (the
    ranks' rows joined) and the params. LocalSGD(k_steps=2) runs `cond`
    with its c_allreduce_sums inside, averaging at steps 2 and 4."""
    (jmain, rj, jfetch), (tmain, rt, tfetch), scj, pers = _spmd_pair(kind)
    params = [p.name for p in jmain.all_parameters()]
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    sct = ptt.Scope()
    _resync(sct, scj, pers)
    rng = np.random.RandomState(3)
    feed = _feed("mlp", rng, 64)
    for step in range(steps):
        if kind == "grad_allreduce":
            _resync(sct, scj, pers)
        want = rj.run(exej, feed=feed, fetch_list=jfetch, scope=scj)
        got = rt.run(exet, feed=feed, fetch_list=tfetch, scope=sct)
        assert got[0].shape == want[0].shape == (1,)
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        _close(got[1], want[1], f"pred step {step + 1}")
        for n in params:
            _close(sct.get(n), scj.get(n), f"{n} step {step + 1}")
    launches = next(iter(rt._cache.values())).launches
    # one c_allreduce_sum a param a step; LocalSGD's at its 2 averages
    assert launches["c_allreduce_sum"] == len(params) * (
        steps if kind == "grad_allreduce" else steps // 2)


def test_spmd_runner_resize_and_first_rank_fetch():
    """`resize` to a 4-rank mesh drops the prepared steps, and the
    next step runs on 4 ranks as the JAX runner's does after its resize;
    with reduce="first" a scalar fetch is rank 0's, in both packages."""
    (jmain, rj, jfetch), (tmain, rt, tfetch), scj, pers = \
        _spmd_pair("grad_allreduce")
    params = [p.name for p in jmain.all_parameters()]
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    sct = ptt.Scope()
    feed = _feed("mlp", np.random.RandomState(4), 64)
    mesh_j = jpar.make_mesh(jpar.MeshConfig(dp=4), devices=jax.devices()[:4])
    mesh_t = tpar.make_mesh(tpar.MeshConfig(dp=4), devices=["cpu"] * 4)
    for resized in (False, True):
        if resized:
            rj.resize(mesh_j)
            assert rt.resize(mesh_t) is rt and not rt._cache
        _resync(sct, scj, pers)
        want = rj.run(exej, feed=feed, fetch_list=jfetch, scope=scj)
        got = rt.run(exet, feed=feed, fetch_list=tfetch, scope=sct)
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        for n in params:
            _close(sct.get(n), scj.get(n), f"{n} resized={resized}")
    assert next(iter(rt._cache.values())).ring.size == 4
    _resync(sct, scj, pers)
    firsts = []
    for pkg, par, main, devs, scope in (
            (pt, jpar, jmain, jax.devices(), scj),
            (ptt, tpar, tmain, ["cpu"] * RANKS, sct)):
        r = par.SPMDRunner(main, par.make_mesh(par.MeshConfig(dp=RANKS),
                                               devices=devs),
                           reduce="first")
        firsts.append(r.run(pkg.Executor(pkg.CPUPlace()), feed=feed,
                            fetch_list=[jfetch[0].name], scope=scope)[0])
    np.testing.assert_allclose(firsts[1], firsts[0], rtol=LOSS_RTOL)


# -- the c_* ops under the runners ----------------------------------

def _c_case(op, attrs=None, shape=(16, 4), grad=True, x="normal",
            name=None):
    return pytest.param(op, attrs or {}, shape, grad, x, id=name or op)


C_CASES = [
    _c_case("c_allreduce_sum"),
    _c_case("c_allreduce_max", grad=False),
    _c_case("c_allreduce_min", grad=False),
    _c_case("c_allreduce_prod", grad=False, x="pos"),
    _c_case("c_allreduce_prod", grad=False, x="normal",
            name="c_allreduce_prod_negative_nan"),
    _c_case("c_broadcast", {"root": 3}),
    _c_case("c_allgather", {"nranks": RANKS}),
    _c_case("c_reducescatter", {"nranks": RANKS}, shape=(64, 4)),
    _c_case("c_ppermute", {"shift": 3}),
    _c_case("c_dgc_allreduce", {"k": 5}, shape=(16, 8), grad=False),
    _c_case("c_embedding", {"start_index": 6}),
] + [_c_case(op, grad=False) for op in (
    "c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "c_sync_calc_stream",
    "c_sync_comm_stream", "c_wait_compute", "c_wait_comm")]


def _c_program(pkg, op, attrs, shape, grad):
    """`x` (fed, [N, ...]) -> op -> out; with `grad`, the gradient of
    sum(out * r) (r fed) with respect to the op's differentiable input."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=list(shape[1:]), dtype="float32")
        block = main.global_block()
        if op == "c_embedding":
            ids = pkg.layers.data(name="ids", shape=[], dtype="int64")
            wrt = pkg.layers.create_parameter([10, shape[1]], "float32",
                                              name="w")
            inputs = {"W": wrt, "Ids": ids}
            out_shape = (-1, shape[1])
        else:
            wrt, inputs = x, {"X": x}
            out_shape = None
        out = block.create_var(name="out", dtype="float32", shape=out_shape)
        block.append_op(type=op, inputs=inputs, outputs={"Out": out},
                        attrs={"axis_name": "dp", **attrs})
        fetch = [out]
        if grad:
            r = pkg.layers.data(name="r", shape=[-1] + list(shape[1:]),
                                dtype="float32", append_batch_size=False)
            loss = pkg.layers.reduce_sum(out * r)
            fetch += pkg.gradients([loss], [wrt])
    return main, startup, fetch


@pytest.mark.parametrize("op, attrs, shape, grad, x", C_CASES)
def test_collective_op_matches_jax_under_the_runners(op, attrs, shape, grad,
                                                     x):
    """Each c_* op (and the gradient of those that have one) on 8
    ranks against the JAX op under the JAX runner: every rank's output,
    the ranks' rows joined as the runners fetch them. c_allreduce_prod
    is exp(psum(log x)) in both: a negative entry gives NaN."""
    rng = np.random.RandomState(sum(map(ord, op)) + len(x))
    feed = {"x": (rng.uniform(0.5, 1.5, shape) if x == "pos"
                  else rng.standard_normal(shape)).astype("float32")}
    if op == "c_embedding":
        feed["ids"] = rng.randint(0, 20, shape[0]).astype("int64")
    if grad:
        rows = shape[0] * (RANKS if op == "c_allgather" else 1)
        rows //= RANKS if op == "c_reducescatter" else 1
        feed["r"] = rng.standard_normal((rows,) + shape[1:]).astype(
            "float32")
    jmain, jstart, jfetch = _c_program(pt, op, attrs, shape, grad)
    tmain, tstart, tfetch = _c_program(ptt, op, attrs, shape, grad)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    scj = pt.Scope()
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    exej.run(jstart, scope=scj)
    sct = scope_from_numpy(ptt.Scope(), {
        v.name: scj.get(v.name) for v in jstart.list_vars()
        if v.persistable}, ptt.CPUPlace())
    rj = jpar.SPMDRunner(jmain, jpar.make_mesh(jpar.MeshConfig(dp=RANKS),
                                               devices=jax.devices()))
    rt = tpar.SPMDRunner(tmain, tpar.make_mesh(tpar.MeshConfig(dp=RANKS),
                                               devices=["cpu"] * RANKS))
    want = rj.run(exej, feed=feed, fetch_list=jfetch, scope=scj)
    got = rt.run(exet, feed=feed, fetch_list=tfetch, scope=sct)
    for what, a, b in zip(("out", "grad"), got, want):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{op} {what}")
    if op == "c_allreduce_prod" and x == "normal":
        assert np.isnan(got[0]).any()


def _kernel(pkg, op_type, ins, attrs, outputs=None):
    """One kernel call through `pkg`'s registry (as
    test_torch_fluid_ops.py's `_run`)."""
    names = {slot: [f"{slot}{i}" for i in range(len(v))]
             for slot, v in ins.items()}
    if pkg is pt:
        ctx = jreg.KernelCtx(JOpDesc(type=op_type, inputs=names,
                                     outputs=outputs or {}, attrs=attrs))
        outs = jreg.get_op_def(op_type).call(
            {k: [np.asarray(x) for x in v] for k, v in ins.items()},
            attrs, ctx)
    else:
        ctx = treg.KernelCtx(TOpDesc(type=op_type, inputs=names,
                                     outputs=outputs or {}, attrs=attrs),
                             device="cpu")
        with torch.no_grad():
            outs = treg.get_op_def(op_type).call(
                {k: [torch.from_numpy(np.array(x)) for x in v]
                 for k, v in ins.items()}, attrs, ctx)
    return {k: [np.asarray(o) for o in v] for k, v in outs.items()}


def _ids(rng, shape, hi):
    return rng.randint(0, hi, shape).astype("int64")


KERNEL_CASES = {
    "increment": lambda rng: ({"X": [rng.standard_normal((1,)).astype(
        "float32")]}, {"step": 2.5}),
    "increment_int": lambda rng: ({"X": [np.array([3], "int64")]},
                                  {"step": 1.0}),
    "equal": lambda rng: ({"X": [_ids(rng, (6, 3), 3)],
                           "Y": [_ids(rng, (6, 3), 3)]}, {}),
    "lookup_table_v2": lambda rng: ({
        "W": [rng.standard_normal((7, 4)).astype("float32")],
        "Ids": [_ids(rng, (5, 1), 7)]}, {"padding_idx": 2}),
    "one_hot_v2": lambda rng: ({"X": [np.array([[0], [3], [5], [-1]],
                                               "int64")]}, {"depth": 4}),
    "assign": lambda rng: ({"X": [rng.standard_normal((3, 2)).astype(
        "float32")]}, {}),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_new_op_kernels_match_jax(case):
    """`increment`, `equal`, `lookup_table_v2` (with its W gradient),
    one_hot_v2 (out-of-range ids give zero rows) and assign against the
    JAX kernels, bit for bit."""
    op = case.split("_int")[0]
    ins, attrs = KERNEL_CASES[case](np.random.RandomState(len(case)))
    want, got = _kernel(pt, op, ins, attrs), _kernel(ptt, op, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for a, b in zip(got[slot], want[slot]):
            assert a.dtype == b.dtype and a.shape == b.shape, (slot,)
            np.testing.assert_array_equal(a, b)
    if op == "lookup_table_v2":
        rng = np.random.RandomState(1)
        gins = {"fwd_in::W": ins["W"], "fwd_in::Ids": ins["Ids"],
                "out_grad::Out": [rng.standard_normal(
                    want["Out"][0].shape).astype("float32")]}
        outs = {"in_grad::W": ["gW"]}
        gw = _kernel(pt, op + "_grad", gins, attrs, outs)["in_grad::W"][0]
        gt = _kernel(ptt, op + "_grad", gins, attrs, outs)["in_grad::W"][0]
        np.testing.assert_allclose(gt, gw, rtol=1e-6, atol=1e-7)
        assert not gt[2].any()          # the padding row takes nothing


def _sparse_embedding_step(pkg, v2, is_sparse):
    """One SGD step of sum(embedding(ids)) with ids 0, 1, 2, 1 (id 1
    twice) from the table the JAX package's startup makes: the table."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        if v2:
            ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64")
            emb = pkg.embedding(ids, size=[10, 4], is_sparse=is_sparse)
        else:
            ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
            emb = pkg.layers.embedding(ids, size=[10, 4],
                                       is_sparse=is_sparse)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(
            pkg.layers.reduce_sum(emb))
    assert ("lookup_table_v2" if v2 else "lookup_table") in {
        op.type for op in main.desc.block(0).ops}
    (table,) = [p.name for p in main.all_parameters()]
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    if pkg is ptt:
        from paddle_tpu_torch.convert import scope_from_numpy

        js = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(_sparse_embedding_startup(v2),
                                       scope=js)
        scope_from_numpy(scope, {table: js.get(table)}, ptt.CPUPlace())
    w0 = scope.get(table)
    exe.run(main, feed={"ids": np.array([0, 1, 2, 1]).reshape(4, 1)},
            scope=scope)
    return w0, scope.get(table)


def _sparse_embedding_startup(v2):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        if v2:
            pt.embedding(pt.data(name="ids", shape=[-1, 1], dtype="int64"),
                         size=[10, 4], is_sparse=True)
        else:
            pt.layers.embedding(pt.layers.data(name="ids", shape=[1],
                                               dtype="int64"),
                                size=[10, 4], is_sparse=True)
    return startup


def test_sparse_embedding_gradient_raises():
    """`lookup_table_v2`'s gradient with is_sparse=True was refused
    before SelectedRows came to the port (ROADMAP item 16); now it is a
    SelectedRows, as in the JAX package: one SGD step moves only rows
    0, 1 (twice) and 2, equal to the dense program's step bit for bit
    and to the JAX package's within 1e-6."""
    w0, w = _sparse_embedding_step(ptt, True, True)
    _, w_dense = _sparse_embedding_step(ptt, True, False)
    _, w_jax = _sparse_embedding_step(pt, True, True)
    np.testing.assert_array_equal(w, w_dense)
    np.testing.assert_allclose(w, w_jax, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w0 - w, np.array([1, 2, 1] + [0] * 7)[:, None]
                               * 0.1 * np.ones((10, 4)), atol=1e-6)


def test_sparse_lookup_table_v1_gradient_raises():
    """`lookup_table` (v1, `layers.embedding`) with is_sparse=True: its
    W gradient, once refused (ROADMAP item 16), is a SelectedRows; the
    step equals the dense one bit for bit and the JAX package's within
    1e-6."""
    w0, w = _sparse_embedding_step(ptt, False, True)
    _, w_dense = _sparse_embedding_step(ptt, False, False)
    _, w_jax = _sparse_embedding_step(pt, False, True)
    np.testing.assert_array_equal(w, w_dense)
    np.testing.assert_allclose(w, w_jax, rtol=1e-6, atol=1e-6)
    assert np.array_equal(w[3:], w0[3:])


def _cond_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[3], dtype="float32")
        s = pkg.layers.data(name="s", shape=[1], dtype="float32",
                            append_batch_size=False)
        pred = pkg.layers.equal(s, pkg.layers.fill_constant([1], "float32",
                                                            1.0))
        out = pkg.layers.cond(pred, lambda: pkg.layers.scale(x, 3.0),
                              lambda: pkg.layers.tanh(x))
        grad = pkg.gradients([pkg.layers.reduce_sum(out * out)], [x])
    return main, [out] + grad


@pytest.mark.parametrize("branch", [1.0, 0.0])
def test_cond_matches_jax(branch):
    """`cond`, with `equal` as its predicate, both branches, and
    the gradient through it, against the JAX package's Executor."""
    jmain, jf = _cond_program(pt)
    tmain, tf = _cond_program(ptt)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    feed = {"x": np.random.RandomState(2).standard_normal((4, 3)).astype(
        "float32"), "s": np.array([branch], "float32")}
    want = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed, fetch_list=jf,
                                          scope=pt.Scope())
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed, fetch_list=tf,
                                           scope=ptt.Scope())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6)


# -- the transpilers and the fleet facade ---------------------------

@pytest.mark.parametrize("kind", ["grad_allreduce", "local_sgd_1",
                                  "local_sgd_3"])
def test_transpiled_descs_are_the_jax_packages(kind):
    """GradAllReduce and LocalSGD (k_steps 1, and 3 with its
    cond_state gate) give the JAX package's descs, op for op."""
    descs = []
    for pkg, g, l in ((pt, JGradAllReduce, JLocalSGD),
                      (ptt, GradAllReduce, LocalSGD)):
        main, start, _, _ = _mlp(pkg)
        with pkg.framework.unique_name.guard(), \
                pkg.program_guard(main, start):
            t = g(nranks=4) if kind == "grad_allreduce" else \
                l(nranks=4, k_steps=int(kind[-1]))
            t.transpile(main, start)
        descs.append((main.desc.to_dict(), start.desc.to_dict()))
    assert descs[0] == descs[1]
    types = [op["type"] for op in descs[1][0]["blocks"][0]["ops"]]
    assert types.count("c_allreduce_sum") == (4 if kind != "local_sgd_3"
                                              else 0)


def _fleet_program(pkg, fleet_cls, strategy_cls, role, **st):
    fl = fleet_cls()
    fl.init(role(current_id=0, worker_num=1))
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=32, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        fl.distributed_optimizer(pkg.optimizer.SGD(learning_rate=0.1),
                                 strategy_cls(**st)).minimize(loss)
    return fl, main, startup, loss


@pytest.mark.parametrize("graph", [False, True])
def test_fleet_facade_matches_jax(graph):
    """`test_distributed.py`'s `test_fleet_facade_single_process` flow
    (the loss falls over 10 steps), and with use_graph_collectives the
    program transpiled as the JAX package's fleet does it (dp 8, the
    JAX mesh's), then run by SPMDRunner on fleet.mesh()."""
    from paddle_tpu.parallel import DistributedStrategy as JStrategy
    from paddle_tpu.parallel.fleet import Fleet as JFleet
    from paddle_tpu.parallel.role_maker import UserDefinedRoleMaker as JRole
    from paddle_tpu_torch.incubate.fleet.base.role_maker import \
        UserDefinedRoleMaker
    from paddle_tpu_torch.incubate.fleet.collective import \
        DistributedStrategy
    from paddle_tpu_torch.parallel.fleet import Fleet

    st = dict(use_graph_collectives=graph,
              data_parallel_degree=RANKS if graph else -1)
    _, jmain, _, _ = _fleet_program(pt, JFleet, JStrategy, JRole, **st)
    fl, main, startup, loss = _fleet_program(
        ptt, Fleet, DistributedStrategy, UserDefinedRoleMaker, **st)
    assert main.desc.to_dict() == jmain.desc.to_dict()
    assert fl.is_first_worker() and fl.worker_num() == 1
    exe = ptt.Executor(ptt.CPUPlace())
    feed = _feed("mlp", np.random.RandomState(3), 64)
    run = (lambda s: tpar.SPMDRunner(main, fl.mesh(device="cpu")).run(
        exe, feed=feed, fetch_list=[loss], scope=s)) if graph else \
        (lambda s: exe.run(main, feed=feed, fetch_list=[loss], scope=s))
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(run(scope)[0][0]) for _ in range(10)]
    assert losses[-1] < losses[0]
    if graph:
        assert fl.mesh(device="cpu").shape["dp"] == RANKS


@pytest.mark.parametrize("knob, item", [
    ("workers", "20a"), ("use_hierarchical_allreduce", "20a"),
    ("use_amp", "16"), ("recompute", "16"), ("gradient_merge_k", "16"),
    ("use_dgc", "16"), ("lamb", "16")])
def test_fleet_refusals(knob, item):
    """Several workers and hierarchical allreduce raise, naming item
    20a. The strategy's optimizer rewrites (item 16, now ported) build
    the JAX package's program instead; `use_dgc` with an inner
    optimizer that is not DGCMomentum raises ValueError in both."""
    from paddle_tpu.parallel import DistributedStrategy as JStrategy
    from paddle_tpu.parallel.fleet import Fleet as JFleet
    from paddle_tpu.parallel.role_maker import UserDefinedRoleMaker as JRole
    from paddle_tpu_torch.parallel import DistributedStrategy
    from paddle_tpu_torch.parallel.fleet import Fleet
    from paddle_tpu_torch.parallel.role_maker import UserDefinedRoleMaker

    fl = Fleet()
    if knob == "workers":
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            fl.init(UserDefinedRoleMaker(current_id=0, worker_num=2))
        return
    value = 2 if knob == "gradient_merge_k" else True
    descs = []
    for pkg, fleet_cls, strategy_cls, role in (
            (ptt, Fleet, DistributedStrategy, UserDefinedRoleMaker),
            (pt, JFleet, JStrategy, JRole)):
        fl = fleet_cls()
        fl.init(role(current_id=0, worker_num=1))
        main, startup = pkg.Program(), pkg.Program()
        with pkg.framework.unique_name.guard(), \
                pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[4], dtype="float32")
            loss = pkg.layers.mean(pkg.layers.fc(input=x, size=1))
            opt = fl.distributed_optimizer(
                pkg.optimizer.SGD(learning_rate=0.1),
                strategy_cls(**{knob: value}))
            if item == "20a":
                with pytest.raises(NotImplementedError,
                                   match=f"item {item}"):
                    opt.minimize(loss)
                return
            if knob == "use_dgc":
                with pytest.raises(ValueError, match="DGCMomentum"):
                    opt.minimize(loss)
                opt = fl.distributed_optimizer(
                    pkg.optimizer.DGCMomentumOptimizer(0.1, momentum=0.9),
                    strategy_cls(use_dgc=True))
            opt.minimize(loss)
        descs.append((main.desc.to_dict(), startup.desc.to_dict()))
    assert descs[0] == descs[1]


# -- ParallelExecutor ------------------------------------------------

def test_parallel_executor_matches_compiled_program(monkeypatch):
    """The legacy facade (fetch_list first, the feed_dict alias,
    drop_local_exe_scopes) is CompiledProgram's engine: with CPU_NUM=8
    its 8 steps equal CompiledProgram's on cpu_places() bit for bit; a
    multi-trainer run raises."""
    monkeypatch.setenv("CPU_NUM", str(RANKS))
    feed = _feed("mlp", np.random.RandomState(3), 64)

    def losses(make_run):
        main, startup, (loss,), _ = _mlp(ptt)
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        run = make_run(main, loss, scope, exe)
        return [float(run(i)[0][0]) for i in range(8)]

    def compiled(main, loss, scope, exe):
        prog = ptt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        return lambda i: exe.run(prog, feed=feed, fetch_list=[loss],
                                 scope=scope)

    def legacy(main, loss, scope, exe):
        pe = ptt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                  main_program=main, scope=scope)
        pe.drop_local_exe_scopes()
        return lambda i: pe.run([loss], feed=feed) if i < 4 else \
            pe.run(fetch_list=[loss], feed_dict=feed)

    assert losses(legacy) == losses(compiled)
    main, _, (loss,), _ = _mlp(ptt)
    with pytest.raises(RuntimeError, match="num_trainers"):
        ptt.ParallelExecutor(True, loss_name=loss.name, main_program=main,
                             num_trainers=2)


def test_parallel_executor_never_defaults_to_the_cpu():
    """`use_cuda` is required, as in the reference: built without it the
    facade raises instead of running on the CPU, and `use_cuda=True`
    places its executor on CUDAPlace(0), which raises without a card."""
    main, _, (loss,), _ = _mlp(ptt)
    with pytest.raises(TypeError, match="use_cuda"):
        ptt.ParallelExecutor(loss_name=loss.name, main_program=main)
    if torch.cuda.is_available():
        pe = ptt.ParallelExecutor(True, loss_name=loss.name,
                                  main_program=main)
        assert isinstance(pe._exe.place, ptt.CUDAPlace)
    else:
        with pytest.raises(RuntimeError):
            ptt.ParallelExecutor(True, loss_name=loss.name,
                                 main_program=main)


# -- the top-level fluid conveniences --------------------------------

def _conveniences(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        with pkg.name_scope("block"), pkg.device_guard("gpu"):
            img = pkg.data(name="img", shape=[None, 3, 8, 8])
            ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64")
            emb = pkg.embedding(ids, size=[20, 6], padding_idx=-1)
            hot = pkg.one_hot(ids, depth=20)
            out = pkg.layers.reduce_sum(emb) + pkg.layers.reduce_sum(hot) + \
                pkg.layers.reduce_mean(img)
    return main, startup, out


def test_fluid_conveniences_build_the_jax_packages_descs():
    """`fluid.data` (batch dim included), fluid.embedding
    (lookup_table_v2) and fluid.one_hot (one_hot_v2) under name_scope and
    device_guard build the JAX package's descs; the program runs."""
    mj, sj, _ = _conveniences(pt)
    mt, st, out = _conveniences(ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()
    assert ptt.fluid is ptt
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(st, scope=scope)
    rng = np.random.RandomState(0)
    got, = exe.run(mt, feed={"img": rng.rand(2, 3, 8, 8).astype("float32"),
                             "ids": rng.randint(0, 20, (2, 1))},
                   fetch_list=[out], scope=scope)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["places", "lod", "op_library", "version",
                                  "memory", "exports"])
def test_fluid_convenience_behaviour(name, monkeypatch):
    """`cpu_places` reads CPU_NUM, cuda_places raises without a card
    (no CPU fallback), create_lod_tensor and load_op_library raise
    without a word of TPU, require_version as the JAX package's,
    memory_optimize and release_memory warn, and the exports exist."""
    if name == "places":
        monkeypatch.setenv("CPU_NUM", "3")
        assert ptt.cpu_places() == [ptt.CPUPlace()] * 3
        assert len(ptt.cpu_places(2)) == 2
        assert ptt.CUDAPinnedPlace().torch_device().type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ptt.cuda_places()
            assert not ptt.is_compiled_with_tpu()
    elif name in ("lod", "op_library"):
        fn = ptt.create_lod_tensor if name == "lod" else \
            ptt.load_op_library
        with pytest.raises(NotImplementedError) as e:
            fn("x")
        assert "TPU" not in str(e.value)
    elif name == "version":
        assert ptt.__version__ == pt.__version__
        for lo, hi in (("0.0.9", None), ("0.1", "0.1.0"), ("0.2", None),
                       ("0.0.1", "0.0.9")):
            outcome = []
            for pkg in (pt, ptt):
                try:
                    pkg.require_version(lo, hi)
                    outcome.append("ok")
                except RuntimeError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1], (lo, hi, outcome)
    elif name == "memory":
        for fn in (ptt.memory_optimize, ptt.release_memory):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                fn(None)
            assert w and issubclass(w[0].category, DeprecationWarning)
    else:
        for n in ("CompiledProgram", "BuildStrategy", "ExecutionStrategy",
                  "ParallelExecutor", "CUDAPinnedPlace",
                  "is_compiled_with_tpu"):
            assert getattr(ptt, n) is not None, n
        for n in ("SPMDRunner", "fleet", "DistributedStrategy",
                  "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
                  "RoleMakerBase", "Role"):
            assert getattr(tpar, n) is not None, n
        assert sorted(vars(ptt.BuildStrategy())) == \
            sorted(vars(pt.BuildStrategy()))
        assert sorted(vars(ptt.ExecutionStrategy())) == \
            sorted(vars(pt.ExecutionStrategy()))


# -- rule (d): the ops no cheaper rule takes gather ---------------


def _gather_op(pkg, kind, h, z):
    """The output of kind's op (or ops) on h and z [N, 6] (h [N, 4, 3, 3]
    for instance_norm); `_split_op_program` builds around it."""
    L = pkg.layers
    blk = pkg.default_main_program().global_block()

    def op(type_, ins, attrs=None, outs=("Out",), ints=()):
        vs = {s: blk.create_var(name=f"{kind}.{s.lower()}",
                                dtype="int64" if s in ints else "float32")
              for s in outs}
        blk.append_op(type=type_, inputs=ins,
                      outputs={s: [v] for s, v in vs.items()},
                      attrs=attrs or {})
        return vs[outs[0]]

    if kind == "softmax_axis0":
        # h * z: a softmax over dim 0 does not see h's bias, a shift of
        # each column
        return L.softmax(L.elementwise_mul(h, z), axis=0)
    if kind == "kron":
        return op("kron", {"X": [h], "Y": [z]})
    if kind == "reshape":
        return L.reshape(h, [2, -1])
    if kind == "transpose_batch":
        return L.transpose(h, perm=[1, 0])
    if kind == "concat_axis0":
        return L.concat([h, z], axis=0)
    if kind == "split_axis0":
        a, b = L.split(h, 2, dim=0)
        return L.elementwise_mul(a, b)
    if kind == "stack_axis0":
        return L.stack([h, z], axis=0)
    if kind == "slice_axis0":
        return L.slice(h, axes=[0], starts=[1], ends=[7])
    if kind == "expand_batch":
        return L.expand(h, [2, 1])
    if kind == "top_k_batch":
        return L.topk(L.reshape(h, [-1]), k=5)[0]
    if kind in ("logsumexp_batch", "frobenius_norm_batch"):
        return op(kind[:-len("_batch")], {"X": [h]},
                  {"dim": [0], "keep_dim": False, "reduce_all": False})
    if kind == "instance_norm_b1":
        return L.instance_norm(h)
    if kind == "sigmoid_xent_normalize":
        return L.sigmoid_cross_entropy_with_logits(h, L.sigmoid(z),
                                                   normalize=True)
    if kind == "kldiv_mean":
        return L.kldiv_loss(L.log_softmax(h), L.softmax(z),
                            reduction="mean")
    if kind == "bmm":
        return op("bmm", {"X": [L.reshape(h, [-1, 2, 3])],
                          "Y": [L.reshape(z, [-1, 3, 2])]})
    if kind == "dot":
        return op("dot", {"X": [h], "Y": [z]})
    if kind == "addmm":
        w = L.create_parameter([6, 6], "float32", name="addmm_w")
        return op("addmm", {"Input": [z], "X": [h], "Y": [w]},
                  {"Alpha": 1.0, "Beta": 0.5})
    if kind == "trace":
        return op("trace", {"Input": [h]}, {"offset": 0, "axis1": 0,
                                            "axis2": 1})
    if kind == "where":
        return op("where", {"Condition": [L.less_than(h, z)], "X": [h],
                            "Y": [z]})
    if kind == "argsort_batch":
        return L.argsort(h, axis=0)[0]
    if kind == "cumsum_batch":
        return L.cumsum(h, axis=0)
    if kind == "isinf_v1":
        flag = blk.create_var(name="isinf.out", dtype="bool")
        blk.append_op(type="isinf", inputs={"X": [h]},
                      outputs={"Out": [flag]})
        return L.elementwise_mul(h, L.scale(L.cast(flag, "float32"),
                                            bias=1.0))
    if kind == "maximum":
        return op("maximum", {"X": [h], "Y": [z]})
    if kind == "l1_norm":
        return op("l1_norm", {"X": [h]})
    if kind == "p_norm_batch":
        return op("p_norm", {"X": [h]}, {"porder": 3.0, "axis": 0})
    if kind == "clip":
        return L.clip(h, -0.5, 0.5)
    assert kind == "l2_normalize_batch", kind
    return L.l2_normalize(h, axis=0)


# kind -> (the op type rule (d) must gather, the batch)
GATHER_KINDS = {
    "softmax_axis0": ("softmax", 8), "kron": ("kron", 8),
    "reshape": ("reshape2", 8), "transpose_batch": ("transpose2", 8),
    "concat_axis0": ("concat", 8), "split_axis0": ("split", 8),
    "stack_axis0": ("stack", 8), "slice_axis0": ("slice", 8),
    "expand_batch": ("expand", 8), "top_k_batch": ("top_k", 8),
    "logsumexp_batch": ("logsumexp", 8),
    "frobenius_norm_batch": ("frobenius_norm", 8),
    "instance_norm_b1": ("instance_norm", 2),
    "sigmoid_xent_normalize": ("sigmoid_cross_entropy_with_logits", 8),
    "kldiv_mean": ("kldiv_loss", 8), "bmm": ("bmm", 8), "dot": ("dot", 8),
    "addmm": ("addmm", 8), "trace": ("trace", 8), "where": ("where", 8),
    "argsort_batch": ("argsort", 8), "cumsum_batch": ("cumsum", 8),
    "isinf_v1": ("isinf", 8), "maximum": ("maximum", 8),
    "l1_norm": ("l1_norm", 8), "p_norm_batch": ("p_norm", 8),
    "clip": ("clip", 8), "l2_normalize_batch": ("l2_normalize", 8)}


def _split_op_program(pkg, kind):
    """A program around kind's op: x [N, 6] (or [N, 4, 3, 3]) through an
    fc (a scale for the image), z [N, 6], at the static batch N that
    the feeds have, the op, and the mean square of an fc of a 2-D or
    wider output to one column, or of a narrower output (a plain mean
    of an fc of a normalized output would be constant). SGD 0.1."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    L = pkg.layers
    img = kind == "instance_norm_b1"
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        n = GATHER_KINDS[kind][1]
        x = L.data(name="x", shape=[n, 4, 3, 3] if img else [n, 6],
                   dtype="float32", append_batch_size=False)
        z = L.data(name="z", shape=[n, 6], dtype="float32",
                   append_batch_size=False)
        h = L.scale(x, scale=1.5) if img else L.fc(x, size=6)
        out = _gather_op(pkg, kind, h, z)
        loss = L.mean(L.square(L.fc(out, size=1) if len(out.shape) >= 2
                               else out))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind", sorted(GATHER_KINDS))
def test_an_op_no_rule_covers_gathers(kind, monkeypatch):
    """Rule (d): an op with a batch-split input that no cheaper rule
    takes (a shape op across dim 0, a softmax, top_k or norm over the
    batch, instance_norm on a batch of 1 a rank, a normalizing or
    reducing loss, bmm, kron, trace, where, cumsum, ...) runs once over
    the whole batch under `with_data_parallel` on 2 CPU ranks: the loss
    at rtol 1e-5 and every parameter gradient within 1e-5 of its
    tensor's largest value, against the JAX package's one-device
    Executor and against the port's one rank."""
    from paddle_tpu_torch.core import lockstep

    op_type, n = GATHER_KINDS[kind]
    jm, js, jl = _split_op_program(pt, kind)
    tm, ts, tl = _split_op_program(ptt, kind)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=scj)
    pers = [v.name for v in js.list_vars() if v.persistable]
    params = [p.name for p in jm.all_parameters()
              if jm.global_block().has_var(p.name + "@GRAD")]
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    rng = np.random.RandomState(len(kind))
    feed = {"x": rng.standard_normal((n, 4, 3, 3) if n == 2 else (n, 6))
            .astype("float32"),
            "z": rng.standard_normal((n, 6)).astype("float32")}
    one, two = ptt.Scope(), ptt.Scope()
    for sc in (one, two):
        _resync(sc, scj, pers)
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=scj)
    gathered = []
    real = lockstep.Lockstep._gather

    def spy(self, op, envs, block, first_grad):
        gathered.append(op.type)
        return real(self, op, envs, block, first_grad)

    monkeypatch.setattr(lockstep.Lockstep, "_gather", spy)
    exe = ptt.Executor(ptt.CPUPlace())
    single = exe.run(tm, feed=feed, fetch_list=fetch, scope=one)
    ct = ptt.CompiledProgram(tm).with_data_parallel(
        loss_name=tl.name, places=ptt.cpu_places(2))
    got = exe.run(ct, feed=feed, fetch_list=fetch, scope=two)
    assert op_type in gathered, gathered
    for ref, what in ((want, "jax"), (single, "one rank")):
        np.testing.assert_allclose(got[0], ref[0], rtol=LOSS_RTOL,
                                   err_msg=what)
        for name, a, b in zip(params, got[1:], ref[1:]):
            _close(a, b, f"{kind} against {what}: {name}@GRAD")


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_card_gather_program_matches_jax(ranks):
    """`chip_smoke.gather_rule_program` (phase 28 (e): softmax, transpose2,
    concat, kron, top_k_v2 and a reducing kldiv_loss across the batch)
    at 16 x 32 under `with_data_parallel` on 2 and 4 CPU ranks against
    the JAX package's one-device Executor: the loss at rtol 1e-5, every
    parameter gradient within 1e-5 of its tensor's largest value."""
    jm, js, jl = chip_smoke.gather_rule_program(pt, 16, 32)
    tm, ts, tl = chip_smoke.gather_rule_program(ptt, 16, 32)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=scj)
    pers = [v.name for v in js.list_vars() if v.persistable]
    sct = ptt.Scope()
    _resync(sct, scj, pers)
    params = [p.name for p in jm.all_parameters()
              if jm.global_block().has_var(p.name + "@GRAD")]
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    feed = {"x": np.random.RandomState(28).standard_normal((16, 32))
            .astype("float32")}
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=scj)
    ct = ptt.CompiledProgram(tm).with_data_parallel(
        loss_name=tl.name, places=ptt.cpu_places(ranks))
    got = ptt.Executor(ptt.CPUPlace()).run(ct, feed=feed, fetch_list=fetch,
                                           scope=sct)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for n, a, b in zip(params, got[1:], want[1:]):
        _close(a, b, f"{n}@GRAD")


def test_a_gathered_output_is_split_again():
    """A gathered op's output whose dim 0 is the whole batch (softmax
    over dim 0, [8, 6]) is split again by the ranks' rows, so the row op
    after it (a relu) runs on each rank's 4 rows, and one of another
    dim 0 (the [6, 8] transpose) is whole on every rank; the fetches
    equal the one-rank run's."""
    from paddle_tpu_torch.core import lockstep

    main, startup = ptt.Program(), ptt.Program()
    L = ptt.layers
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        x = L.data(name="x", shape=[6], dtype="float32")
        sm = L.softmax(x, axis=0)
        act = L.relu(L.scale(sm, scale=2.0, bias=-0.2))
        tr = L.transpose(x, perm=[1, 0])
    seen = []
    run_ranks = lockstep.RankStep.run_ranks

    def spy(self, envs, seeds, device):
        out = run_ranks(self, envs, seeds, device)
        seen.append(out)
        return out

    feed = {"x": np.random.RandomState(3).standard_normal((8, 6))
            .astype("float32")}
    exe = ptt.Executor(ptt.CPUPlace())
    want = exe.run(main, feed=feed, fetch_list=[sm, act, tr],
                   scope=ptt.Scope())
    ct = ptt.CompiledProgram(main).with_data_parallel(
        places=ptt.cpu_places(2))
    import unittest.mock

    with unittest.mock.patch.object(lockstep.RankStep, "run_ranks", spy):
        got = exe.run(ct, feed=feed, fetch_list=[sm, act, tr],
                      scope=ptt.Scope())
    envs, split = seen[-1]
    assert sm.name in split and act.name in split and tr.name not in split
    assert [tuple(e[act.name].shape) for e in envs] == [(4, 6)] * 2
    assert all(e[tr.name] is envs[0][tr.name] for e in envs)
    assert tuple(envs[0][tr.name].shape) == (6, 8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_a_random_op_still_raises_under_the_gather_rule():
    """A random op other than dropout with a batch-split input raises
    under CompiledProgram, naming itself: its draws over the whole batch
    are not split by rank."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[6], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="int64")
        out = ptt.layers.sampled_softmax_with_cross_entropy(x, y,
                                                            num_samples=3)
    prog = ptt.CompiledProgram(main).with_data_parallel(
        places=ptt.cpu_places(2))
    with pytest.raises(NotImplementedError,
                       match="sampled_softmax_with_cross_entropy: .*random"):
        ptt.Executor(ptt.CPUPlace()).run(
            prog, feed={"x": np.ones((8, 6), "float32"),
                        "y": np.zeros((8, 1), "int64")},
            fetch_list=[out], scope=ptt.Scope())


@pytest.mark.parametrize("runner", ["compiled", "spmd"])
def test_indivisible_batch_raises(runner):
    """A feed whose batch the ranks do not divide raises in both
    packages (the SPMD runner with the JAX runner's message)."""
    feed = _feed("mlp", np.random.RandomState(0), 12)
    msg = {}
    for pkg, par in ((pt, jpar), (ptt, tpar)):
        main, startup, (loss,), _ = _mlp(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        if runner == "compiled":
            kw = {} if pkg is pt else {"places": ptt.cpu_places(RANKS)}
            prog = pkg.CompiledProgram(main).with_data_parallel(**kw)
            run = lambda: exe.run(prog, feed=feed, fetch_list=[loss],  # noqa
                                  scope=scope)
        else:
            devs = jax.devices() if pkg is pt else ["cpu"] * RANKS
            r = par.SPMDRunner(main, par.make_mesh(
                par.MeshConfig(dp=RANKS), devices=devs))
            run = lambda: r.run(exe, feed=feed, fetch_list=[loss],  # noqa
                                scope=scope)
        with pytest.raises(Exception) as e:
            run()
        msg[pkg.__name__] = str(e.value)
    assert "12" in msg["paddle_tpu_torch"] and \
        "not divisible by 8" in msg["paddle_tpu_torch"]
    if runner == "spmd":
        assert msg["paddle_tpu_torch"] == msg["paddle_tpu"]


@pytest.mark.parametrize("where", ["executor", "compiled", "wrong_axis"])
def test_a_collective_outside_a_dp_context_raises(where):
    """A c_* op outside an SPMDRunner's ranks raises, naming itself,
    rather than act as the identity: under a plain Executor, under
    CompiledProgram (no axis to reduce over, as under the JAX package's
    GSPMD jit), and over an axis the runner is not on."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        out = main.global_block().create_var(name="out", dtype="float32")
        main.global_block().append_op(type="c_allreduce_sum",
                                      inputs={"X": x}, outputs={"Out": out})
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {"x": np.ones((8, 4), "float32")}
    if where == "executor":
        with pytest.raises(RuntimeError, match="c_allreduce_sum"):
            exe.run(main, feed=feed, fetch_list=[out], scope=ptt.Scope())
    elif where == "compiled":
        prog = ptt.CompiledProgram(main).with_data_parallel(
            places=ptt.cpu_places(2))
        with pytest.raises(RuntimeError, match="c_allreduce_sum"):
            exe.run(prog, feed=feed, fetch_list=[out], scope=ptt.Scope())
    else:
        r = tpar.SPMDRunner(main, tpar.make_mesh(tpar.MeshConfig(dp=2),
                                                 devices=["cpu"] * 2))
        with pytest.raises(ValueError, match="c_allreduce_sum.*'data'"):
            r.run(exe, feed=feed, fetch_list=[out], scope=ptt.Scope())


def test_plain_executor_under_a_dp_mesh_raises():
    """A plain Executor.run and run_chained under a mesh with dp 2
    raise (one rank cannot pass for the split run); a CompiledProgram
    runs there."""
    main, startup, (loss,), _ = _mlp(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    feed = _feed("mlp", np.random.RandomState(0), 8)
    mesh = tpar.make_mesh(tpar.MeshConfig(dp=2), devices=["cpu"] * 2)
    with tpar.mesh_guard(mesh):
        for run in (exe.run, exe.run_chained):
            with pytest.raises(NotImplementedError, match="20c-iii"):
                run(main, feed=feed, fetch_list=[loss], scope=scope)
        prog = ptt.CompiledProgram(main).with_data_parallel(
            places=ptt.cpu_places(2))
        assert np.isfinite(exe.run(prog, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]).all()


def test_places_off_the_executors_device_raise():
    main, _, (loss,), _ = _mlp(ptt)
    prog = ptt.CompiledProgram(main).with_data_parallel(
        places=[ptt.CPUPlace(), ptt.CUDAPinnedPlace()])
    with pytest.raises(ValueError, match="not all on the executor's"):
        prog._ranks(type("E", (), {"device": torch.device("cuda", 0)})())


# -- telemetry -----------------------------------------------------

def test_spmd_and_sharded_telemetry_rows_match_jax():
    """After the same runs, record_spmd_step's rows (steps and the
    c_* census by axis) and executor_step("sharded")'s steps grow alike
    in both packages, and both hold a perfwatch "spmd" sample."""
    def rows(tel):
        return (tel.SPMD_STEPS.value(axis="dp"),
                tel.SPMD_COLLECTIVES.value(axis="dp", op="c_allreduce_sum"),
                tel.EXEC_STEPS.value(mode="sharded"))

    before = {"jax": rows(jtel), "torch": rows(ttel)}
    (jmain, rj, jfetch), (tmain, rt, tfetch), scj, pers = \
        _spmd_pair("grad_allreduce")
    sct = ptt.Scope()
    _resync(sct, scj, pers)
    feed = _feed("mlp", np.random.RandomState(3), 64)
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    for _ in range(3):
        rj.run(exej, feed=feed, fetch_list=jfetch, scope=scj)
        rt.run(exet, feed=feed, fetch_list=tfetch, scope=sct)
    cj = pt.CompiledProgram(jmain).with_data_parallel()
    main, startup, (loss,), _ = _mlp(ptt)
    ct = ptt.CompiledProgram(main).with_data_parallel(
        places=ptt.cpu_places(RANKS))
    mj, sj, (lj,), _ = _mlp(pt)
    cj = pt.CompiledProgram(mj).with_data_parallel()
    for exe, prog, start, l, scope in ((exej, cj, sj, lj, pt.Scope()),
                                       (exet, ct, startup, loss,
                                        ptt.Scope())):
        exe.run(start, scope=scope)
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=[l], scope=scope)
    after = {"jax": rows(jtel), "torch": rows(ttel)}
    grew = {k: [a - b for a, b in zip(after[k], before[k])] for k in after}
    assert grew["torch"] == grew["jax"] == [3, 3 * 4, 2]
    spmd = tperf.snapshot()["spmd"]
    assert spmd["steps"] >= 3 and spmd["device_kind"] == "cpu"


# -- the library core's rules: sync batch norm on
# the book's VGG-16-BN, and a row-op case for each new rule


def _vgg_pair():
    """The narrow VGG-16-BN of tests/test_torch_fluid_book.py (channels
    / 8, drop rates 0) in both packages."""
    narrow = dict(drop=0.0, width=8)
    jp, tp = (chip_smoke.vgg_bn_program(pkg, **narrow) for pkg in (pt, ptt))
    assert tp[0].desc.to_dict() == jp[0].desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(jp[1], scope=scj)
    pers = [v.name for v in jp[1].list_vars() if v.persistable]
    return jp, tp, scj, pers


@pytest.mark.parametrize("ranks", [2, 4])
def test_vgg_sync_batch_norm_matches_the_whole_batch(ranks, monkeypatch):
    """The narrow VGG-16-BN under `with_data_parallel` on 2 and 4 CPU
    ranks against the JAX package's one-device step over the whole
    batch of 8, three steps each from the JAX state: the loss at rtol
    1e-5, the accuracy exactly, the gradients and the batch norms'
    running stats at tests/test_torch_fluid_book.py's limits (its
    docstring: a gradient under a batch norm moves with the order of
    the reductions); the running stats are one tensor on every rank."""
    from paddle_tpu_torch.core import lockstep

    (mj, _, _, lj, aj), (mt, _, _, lt, _), scj, pers = _vgg_pair()
    params = [p.name for p in mj.all_parameters() if p.trainable]
    stats = chip_smoke.bn_stat_names(mj)
    fetch = [lj.name, aj.name] + [p + "@GRAD" for p in params]
    ct = ptt.CompiledProgram(mt).with_data_parallel(
        loss_name=lt.name, places=ptt.cpu_places(ranks))
    seen = []
    run_ranks = lockstep.RankStep.run_ranks

    def spy(self, envs, seeds, device):
        out = run_ranks(self, envs, seeds, device)
        seen.append(out)
        return out

    monkeypatch.setattr(lockstep.RankStep, "run_ranks", spy)
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    sct = ptt.Scope()
    rng = np.random.RandomState(0)
    for step in range(3):
        feed = {"img": rng.standard_normal((8, 3, 32, 32)).astype(
                    "float32"),
                "label": rng.randint(0, 10, (8, 1)).astype("int64")}
        _resync(sct, scj, pers)
        want = exej.run(mj, feed=feed, fetch_list=fetch, scope=scj)
        got = exet.run(ct, feed=feed, fetch_list=fetch, scope=sct)
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[1], want[1])
        errs = chip_smoke.vgg_grad_errors(mj, params, got[2:], want[2:])
        assert errs["grad"] <= 1e-4 and errs["grad_under_bn"] <= 1e-3, \
            (step + 1, errs)
        for n in stats:
            _close(sct.get(n), scj.get(n), f"{n} step {step + 1}")
        envs, split = seen[-1]
        for n in stats:
            assert n not in split and all(env[n] is envs[0][n]
                                          for env in envs), n
    sstep = next(iter(ct._cache.values()))
    assert sstep.rank_feed_shapes["img"][0] == 8 // ranks


def _row_case(pkg, kind):
    """A program around one op of a new row rule, with a float input x
    [N, 6] (or [N, 4, 3, 3] for the image ops), a label y [N, 1] and,
    for the binary ops, a second float input z [N, 6]; its loss is the
    mean of an fc of the op's output to one column, so the gradients
    pass through it (a plain mean of a normalized output would be 0)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    L = pkg.layers
    img = kind in _IMG_KINDS
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[4, 3, 3] if img else [6],
                   dtype="float32")
        z = L.data(name="z", shape=[6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(x, size=6) if not img else L.scale(x, scale=1.5)
        if kind == "layer_norm":
            out = L.layer_norm(h)
        elif kind == "group_norm":
            out = L.group_norm(h, groups=2)
        elif kind == "instance_norm":
            out = L.instance_norm(h)
        elif kind == "batch_norm_global":
            out = L.batch_norm(h, use_global_stats=True)
        elif kind == "log_softmax":
            out = L.log_softmax(h)
        elif kind == "cross_entropy":
            out = L.cross_entropy(L.softmax(h), y)
        elif kind == "cross_entropy2":
            blk = main.global_block()
            out = blk.create_var(name="xe2", dtype="float32")
            blk.append_op(type="cross_entropy2",
                          inputs={"X": [L.softmax(h)], "Label": [y]},
                          outputs={"Y": [out], "MatchX": [blk.create_var(
                              name="xe2_match", dtype="float32")]})
        elif kind == "sigmoid_xent":
            out = L.sigmoid_cross_entropy_with_logits(h, L.sigmoid(z))
        elif kind == "smooth_l1":
            out = L.smooth_l1(h, z)
        elif kind == "huber_loss":
            out = L.huber_loss(h, z, delta=0.5)
        elif kind == "bce_loss":
            out = L.bce_loss(L.sigmoid(h), L.sigmoid(z))
        elif kind == "margin_rank_loss":
            out = L.margin_rank_loss(L.sign(z), h, L.scale(h, scale=0.5))
        elif kind == "hinge_loss":
            out = L.hinge_loss(h, L.cast(L.less_than(z, h), "float32"))
        elif kind == "kldiv_loss":
            out = L.kldiv_loss(L.log_softmax(h), L.softmax(z),
                               reduction="none")
        elif kind == "label_smooth":
            out = L.label_smooth(L.softmax(h), epsilon=0.1)
        elif kind == "lookup_table":
            out = L.fc(L.reshape(L.embedding(y, size=[10, 5]), [-1, 5]),
                       size=3)
        elif kind == "one_hot":
            out = L.elementwise_mul(L.fc(h, size=10), L.one_hot(y, 10))
        elif kind == "comparisons":
            masks = [L.cast(f(h, z), "float32") for f in (
                L.less_than, L.less_equal, L.greater_than,
                L.greater_equal, L.not_equal)]
            total = masks[0]
            for m in masks[1:]:
                total = L.elementwise_add(total, m)
            out = L.elementwise_mul(h, total)
        elif kind == "cos_sim":
            out = L.cos_sim(h, z)
        elif kind == "concat_split":
            a, b = L.split(L.concat([h, z], axis=1), [4, 8], dim=1)
            out = L.elementwise_add(L.reduce_sum(a, dim=1, keep_dim=True),
                                    L.reduce_sum(b, dim=1, keep_dim=True))
        elif kind == "stack_transpose":
            out = L.transpose(L.stack([h, z], axis=1), perm=[0, 2, 1])
        elif kind == "unsqueeze_squeeze_flatten":
            u = L.unsqueeze(h, axes=[2, 3])
            out = L.flatten(L.squeeze(L.expand(u, [1, 1, 2, 1]), axes=[3]),
                            axis=1)
        elif kind == "slice":
            out = L.slice(h, axes=[1], starts=[1], ends=[4])
        elif kind == "gather":
            table = L.create_parameter([10, 6], "float32", name="table")
            out = L.elementwise_mul(L.gather(table, L.reshape(y, [-1])), h)
        elif kind == "image_convs":
            parts = [L.depthwise_conv2d(h, 4, 3, padding=1),
                     L.conv2d_transpose(h, num_filters=2, filter_size=2),
                     L.pool3d(L.conv3d(L.unsqueeze(h, axes=[2]), 2, 1),
                              pool_size=1)]
            out = L.concat([L.flatten(t, axis=1) for t in parts], axis=1)
        elif kind == "logical":
            lt, gt = L.less_than(h, z), L.greater_than(h, z)
            both = L.logical_or(L.logical_and(lt, L.logical_not(gt)),
                                L.logical_xor(lt, gt))
            blk = main.global_block()
            flags = []
            for op in ("isnan_v2", "isinf_v2"):
                flags.append(blk.create_var(name=op + "_out", dtype="bool"))
                blk.append_op(type=op, inputs={"X": [h]},
                              outputs={"Out": [flags[-1]]})
            out = L.elementwise_mul(h, L.elementwise_add(
                L.cast(both, "float32"), L.cast(L.logical_or(*flags),
                                                "float32")))
        loss = L.mean(L.fc(out, size=1))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


_IMG_KINDS = ("group_norm", "instance_norm", "batch_norm_global",
              "image_convs")
ROW_KINDS = ["layer_norm", "group_norm", "instance_norm",
             "batch_norm_global", "log_softmax", "cross_entropy",
             "cross_entropy2", "sigmoid_xent", "smooth_l1", "huber_loss",
             "bce_loss", "margin_rank_loss", "hinge_loss", "kldiv_loss",
             "label_smooth", "lookup_table", "one_hot", "comparisons",
             "cos_sim", "concat_split", "stack_transpose",
             "unsqueeze_squeeze_flatten", "slice", "gather", "image_convs",
             "logical"]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_row_rule_matches_jax(kind):
    """Each new row rule under `with_data_parallel` on 4 CPU ranks
    against the JAX package's one-device step over the batch of 8:
    the loss at rtol 1e-5, every parameter gradient within 1e-5 of its
    tensor's largest value."""
    jm, js, jl = _row_case(pt, kind)
    tm, ts, tl = _row_case(ptt, kind)
    assert tm.desc.to_dict() == jm.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=scj)
    pers = [v.name for v in js.list_vars() if v.persistable]
    sct = _resync(ptt.Scope(), scj, pers) or ptt.Scope()
    _resync(sct, scj, pers)
    params = [p.name for p in jm.all_parameters()
              if jm.global_block().has_var(p.name + "@GRAD")]
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    rng = np.random.RandomState(len(kind))
    img = kind in _IMG_KINDS
    feed = {"x": rng.standard_normal((8, 4, 3, 3) if img else (8, 6))
            .astype("float32"),
            "z": rng.standard_normal((8, 6)).astype("float32"),
            "y": rng.randint(0, 6, (8, 1)).astype("int64")}
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=scj)
    ct = ptt.CompiledProgram(tm).with_data_parallel(
        loss_name=tl.name, places=ptt.cpu_places(4))
    got = ptt.Executor(ptt.CPUPlace()).run(ct, feed=feed, fetch_list=fetch,
                                           scope=sct)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for n, a, b in zip(params, got[1:], want[1:]):
        _close(a, b, f"{kind}: {n}@GRAD")


@pytest.mark.parametrize("knob", ["use_amp", "recompute", "gradient_merge_k",
                                  "use_dgc", "lamb"])
def test_fleet_strategy_rewrites_run_data_parallel(knob):
    """Each optimizer rewrite of the strategy on the MLP under
    `CompiledProgram.with_data_parallel` at 2 CPU ranks against one
    rank's steps from the same start, 4 steps (gradient merge applies
    on steps 2 and 4): the losses at LOSS_RTOL, every persistable
    within REL of its largest value. use_amp runs mixed_bf16, where
    each rank's weight gradient is a bf16 product over its own rows:
    one step, held at 2**-7 of the largest value (two bf16 ulps;
    measured 1.9e-3), since an MLP at lr 0.1 grows that difference
    step by step (1.3e-2 after four)."""
    from paddle_tpu_torch.parallel import DistributedStrategy
    from paddle_tpu_torch.parallel.fleet import Fleet
    from paddle_tpu_torch.parallel.role_maker import UserDefinedRoleMaker

    fl = Fleet()
    fl.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 5
    with ptt.framework.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[16], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="float32")
        h = ptt.layers.fc(input=x, size=32, act="relu")
        pred = ptt.layers.fc(input=h, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(input=pred,
                                                            label=y))
        inner = ptt.optimizer.DGCMomentumOptimizer(
            0.05, momentum=0.9, sparsity=[0.5]) if knob == "use_dgc" \
            else ptt.optimizer.SGD(learning_rate=0.1)
        fl.distributed_optimizer(inner, DistributedStrategy(
            **{knob: 2 if knob == "gradient_merge_k" else True})
        ).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    pers = sorted(v.name for v in main.list_vars() if v.persistable)
    rng = np.random.RandomState(11)
    feeds = [_feed("mlp", rng, 32) for _ in range(1 if knob == "use_amp"
                                                   else 4)]
    rel = 2.0 ** -7 if knob == "use_amp" else REL
    runs = {}
    for ranks in (1, 2):
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        prog = main if ranks == 1 else ptt.CompiledProgram(
            main).with_data_parallel(loss_name=loss.name,
                                     places=[ptt.CPUPlace()] * ranks)
        losses = [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss],
                                           scope=scope)[0]).reshape(()))
                  for f in feeds]
        runs[ranks] = losses, {n: scope.get(n) for n in pers
                               if scope.find_var(n) is not None}
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=LOSS_RTOL)
    for n, want in runs[1][1].items():
        err = np.abs(runs[2][1][n] - want).max()
        assert err <= rel * max(1.0, np.abs(want).max()), (n, err)
