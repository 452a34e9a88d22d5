"""The executor's streaming path and the trainer's front end on the port,
on the CPU: the JAX package's `tests/test_async_exec.py` mirrored
(prefetcher lifecycle, in-flight bounds, `run_stream`, the streaming
trainer, its preemption, fault-spec and numerics tests, the Hogwild
trainer), held against that package where both run: `run_stream` and
`train_from_dataset` leave the scope equal to per-step `run` (bit for
bit on the port, within 1e-5 of the tensor's largest value against the
JAX package), and the readers, `DataFeeder`, `reader_decorators` and
`metrics` give the JAX package's batches and numbers on the same
inputs.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability import health as jhealth
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import preemption as jpreemption

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import async_exec
from paddle_tpu_torch.core.executor import RNG_STATE_VAR
from paddle_tpu_torch.observability import events
from paddle_tpu_torch.observability import health
from paddle_tpu_torch.observability import telemetry
from paddle_tpu_torch.resilience import faults, preemption

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("PADDLE_TPU_FAULT_SPEC", "PADDLE_TPU_CHECK_NUMERICS",
              "PADDLE_TPU_STREAM_WINDOW", "PADDLE_TPU_DEVICE_PREFETCH",
              "PADDLE_TPU_VALIDATE"):
        monkeypatch.delenv(k, raising=False)
    for mod in (faults, preemption, health, jfaults, jpreemption, jhealth):
        mod.reset()
    async_exec.reset_inflight_stats()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (preemption, jpreemption):
        mod.uninstall()
        mod.reset()
    health.reset()
    jhealth.reset()


def _linreg_program(pkg, opt="sgd"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu")
        h = pkg.layers.dropout(h, dropout_prob=0.2)
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(
            pkg.layers.square_error_cost(input=pred, label=y))
        if opt is not None:
            {"sgd": lambda: pkg.optimizer.SGD(learning_rate=0.05),
             "adam": lambda: pkg.optimizer.Adam(learning_rate=0.01)}[opt]() \
                .minimize(loss)
    return main, startup, loss


def _feeds(rng, n, bs=8):
    W = rng.rand(13, 1)
    out = []
    for _ in range(n):
        X = rng.rand(bs, 13).astype("float32")
        out.append({"x": X, "y": (X @ W).astype("float32")})
    return out


def _no_prefetch_threads():
    return not any(t.name.startswith("paddle-tpu-prefetch")
                   for t in threading.enumerate() if t.is_alive())


def _wait_no_prefetch_threads():
    deadline = time.time() + 5
    while not _no_prefetch_threads() and time.time() < deadline:
        time.sleep(0.01)
    return _no_prefetch_threads()


def _state(scope, main):
    out = {n: scope.get(n) for n in sorted(
        v.name for v in main.list_vars() if v.persistable)
        if scope.find_var(n) is not None}
    return out


# -- FetchHandle / InFlightWindow ---------------------------------------------


def test_fetch_handle_lazy_and_released():
    v = torch.arange(6.0).reshape(2, 3)
    h = async_exec.FetchHandle([v, v + 1], numpy=True, site="unit")
    assert h.raw() is not None and h.ready()
    out = h.result()
    assert isinstance(out[0], np.ndarray)
    np.testing.assert_allclose(out[1], np.arange(6.0).reshape(2, 3) + 1)
    assert h.raw() is None
    assert h.result() is out


def test_inflight_window_bounds_unresolved_handles():
    win = async_exec.InFlightWindow(limit=2)
    handles = []
    for i in range(6):
        h = async_exec.FetchHandle([torch.zeros(3) + i], numpy=True)
        win.admit(h)
        handles.append(h)
        assert sum(1 for x in handles if x.raw() is not None) <= 2
    assert win.high_water <= 2
    assert handles[0].raw() is None and handles[1].raw() is None
    win.drain()
    assert all(h.raw() is None for h in handles)


# -- Prefetcher lifecycle -------------------------------------------------------


def test_prefetcher_basic_and_joined_on_exhaustion():
    """Also: the stage's items reach the telemetry counter
    (`record_prefetch_item`)."""
    before = telemetry.PREFETCH_ITEMS.value(stage="unit")
    pf = async_exec.Prefetcher(iter(range(10)), depth=3, stage="unit")
    assert list(pf) == list(range(10))
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()
    assert telemetry.PREFETCH_ITEMS.value(stage="unit") - before == 10


def test_prefetcher_error_propagates():
    def gen():
        yield 1
        raise RuntimeError("boom-in-producer")

    pf = async_exec.Prefetcher(gen(), depth=2)
    it = iter(pf)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom-in-producer"):
        next(it)
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


def test_prefetcher_early_close_joins_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = async_exec.Prefetcher(endless(), depth=2)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    assert not pf.thread.is_alive()
    pf.close()  # idempotent


def test_loader_producer_error_propagates():
    loader = ptt.DataLoader.from_generator(feed_list=[], capacity=4)

    def bad():
        yield {"x": np.ones((2, 3), "float32")}
        raise ValueError("generator exploded")

    loader.set_batch_generator(bad)
    got = []
    with pytest.raises(ValueError, match="generator exploded"):
        for b in loader():
            got.append(b)
    assert len(got) == 1
    assert _wait_no_prefetch_threads()


def test_loader_early_exit_joins_producer():
    loader = ptt.DataLoader.from_generator(feed_list=[], capacity=2)

    def gen():
        for i in range(1000):
            yield {"x": np.full((2, 2), i, "float32")}

    loader.set_batch_generator(gen)
    for i, b in enumerate(loader()):
        if i == 2:
            break
    assert _wait_no_prefetch_threads()


def test_loader_device_prefetch_gating(monkeypatch):
    def build(places):
        loader = ptt.DataLoader.from_generator(feed_list=[], capacity=4)

        def gen():
            for i in range(3):
                yield {"x": np.full((4, 2), i, "float32")}

        loader.set_batch_generator(gen, places=places)
        return loader

    # CPU places: no transfer to hide, batches stay numpy
    batches = list(build([ptt.CPUPlace()])())
    assert isinstance(batches[0]["x"], np.ndarray)
    # the override puts them on the places' device (the CPU's here)
    monkeypatch.setenv("PADDLE_TPU_DEVICE_PREFETCH", "1")
    batches = list(build([ptt.CPUPlace()])())
    assert len(batches) == 3
    assert isinstance(batches[2]["x"], torch.Tensor)
    np.testing.assert_allclose(batches[2]["x"].numpy(), 2.0)
    assert _wait_no_prefetch_threads()


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a GPU")
def test_device_prefetch_has_no_cpu_fallback(monkeypatch):
    """A prefetch to the card with no places (cuda) raises on a machine
    without one, as does `mesh_device_put` with no mesh."""
    monkeypatch.setenv("PADDLE_TPU_DEVICE_PREFETCH", "1")
    loader = ptt.DataLoader.from_generator(feed_list=[], capacity=4)
    loader.set_batch_generator(lambda: iter([{"x": np.zeros(2, "f")}]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(loader())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        async_exec.DevicePrefetcher(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        async_exec.mesh_device_put({"x": np.zeros(2, "f")})
    assert _wait_no_prefetch_threads()


def test_mesh_device_put_copies_the_batch_whole():
    """Under an in-process mesh the lockstep runtime splits rows, so the
    batch goes up whole to the mesh's device."""
    from paddle_tpu_torch.parallel.mesh import (MeshConfig, make_mesh,
                                                mesh_guard)

    mesh = make_mesh(MeshConfig(dp=2), devices=["cpu"] * 2)
    with mesh_guard(mesh):
        out = async_exec.mesh_device_put(
            {"a": np.arange(8, dtype="float32").reshape(4, 2),
             "b": [np.zeros(3, "float32")]})
    assert out["a"].shape == (4, 2) and out["a"].device.type == "cpu"
    assert isinstance(out["b"], list) and out["b"][0].shape == (3,)


def test_stream_window_default(monkeypatch):
    assert async_exec.stream_window_default() == 8
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "3")
    assert async_exec.stream_window_default() == 3
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "junk")
    assert async_exec.stream_window_default() == 8


# -- run_stream -----------------------------------------------------------------


def _run_port(feeds, window, opt="sgd", feed_tensors=False):
    main, startup, loss = _linreg_program(ptt, opt)
    main.random_seed = 5
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    losses = []
    if window is None:
        for f in feeds:
            losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)[0].reshape(())))
    else:
        src = ({k: torch.from_numpy(v) for k, v in f.items()}
               for f in feeds) if feed_tensors else iter(feeds)
        for h in exe.run_stream(main, src, fetch_list=[loss],
                                window=window, scope=scope):
            assert h.n_steps in (window, len(feeds) % window)
            losses.extend(float(v) for v in h.result()[0].ravel())
    return losses, _state(scope, main), scope.find_var(RNG_STATE_VAR)


@pytest.mark.parametrize("window, tensors", [(4, False), (4, True),
                                             (1, False)])
def test_run_stream_equals_per_step_run(window, tensors):
    """Windows of 4 over 11 steps (a ragged tail), feeds as numpy or as
    tensors: losses, every persistable and the RNG state (dropout draws
    from it) equal to 11 `run` calls, bit for bit."""
    feeds = _feeds(np.random.RandomState(3), 11)
    seq = _run_port(feeds, None, "adam")
    st = _run_port(feeds, window, "adam", feed_tensors=tensors)
    assert st[0] == seq[0]
    assert st[2] == seq[2]
    for n in seq[1]:
        np.testing.assert_array_equal(st[1][n], seq[1][n], err_msg=n)


def test_run_stream_matches_the_jax_package():
    """test_run_stream_matches_per_step on both packages (dropout off):
    the streamed losses and params within 1e-5."""
    feeds = _feeds(np.random.RandomState(4), 9)
    res = {}
    for pkg in (pt, ptt):
        main, startup, loss = _linreg_program(pkg)
        main = main.clone(for_test=False)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        if pkg is pt:
            start = _state(scope, main)
        else:
            from paddle_tpu_torch.convert import scope_from_numpy

            scope_from_numpy(scope, start, ptt.CPUPlace())
        # dropout in test mode on both: torch cannot draw jax's masks
        for op in main.global_block().ops:
            if op.type.startswith("dropout"):
                op.desc.attrs["is_test"] = True
        main._bump_version()
        losses = []
        for h in exe.run_stream(main, iter(feeds), fetch_list=[loss],
                                window=4, scope=scope):
            losses.extend(np.asarray(h.result()[0]).ravel().tolist())
        res[pkg.__name__] = (losses, _state(scope, main))
    (lj, sj), (lt, st) = res["paddle_tpu"], res["paddle_tpu_torch"]
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for n in sj:
        np.testing.assert_allclose(
            st[n], sj[n], rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(sj[n]).max())), err_msg=n)


def test_run_stream_flushes_on_signature_change():
    feeds = _feeds(np.random.RandomState(5), 5, bs=8) + \
        _feeds(np.random.RandomState(6), 2, bs=3)  # short final batches
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        sizes = [(h.start_step, h.n_steps) for h in exe.run_stream(
            main, iter(feeds), fetch_list=[loss], window=4)]
    assert sizes == [(0, 4), (4, 1), (5, 2)]


def test_run_stream_in_flight_cap_and_release():
    feeds = _feeds(np.random.RandomState(7), 20)
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        async_exec.reset_inflight_stats()
        handles = []
        for h in exe.run_stream(main, iter(feeds), fetch_list=[loss],
                                window=5, in_flight=2):
            handles.append(h)
            assert sum(1 for x in handles if x.raw() is not None) <= 2
        assert async_exec.inflight_stats()["high_water"] <= 2
        assert all(h.raw() is None for h in handles)
    total = sum(np.asarray(h.result()[0]).size for h in handles)
    assert total == 20


def test_run_sync_false_and_return_numpy_false():
    feeds = _feeds(np.random.RandomState(11), 1)[0]
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        dev = exe.run(main, feed=feeds, fetch_list=[loss],
                      return_numpy=False)
        assert isinstance(dev[0], torch.Tensor)
        h = exe.run(main, feed=feeds, fetch_list=[loss], sync=False)
        assert isinstance(h, async_exec.FetchHandle)
        assert np.isfinite(h.result()[0]).all()
        ch = exe.run_chained(main, feed=feeds, fetch_list=[loss],
                             n_steps=3, return_numpy=False)
        assert isinstance(ch[0], torch.Tensor) and ch[0].shape[0] == 3


def test_program_cache_is_not_fooled_by_a_reused_program_id():
    """A program that is freed may leave its id() to the next one built.
    The executor's cache must not hand the new program the old one's
    prepared step, even at an equal version, feed signature and fetch
    list: one executor runs one program after another, as a sweep over
    optimizers does, and each gives its own answer."""
    exe = ptt.Executor(ptt.CPUPlace())
    x = np.ones((2, 3), "float32")
    seen = set()
    reused = 0
    with ptt.scope_guard(ptt.Scope()):
        for i in range(50):
            main = ptt.Program()
            with ptt.framework.unique_name.guard(), \
                    ptt.program_guard(main, ptt.Program()):
                xv = ptt.layers.data(name="x", shape=[3], dtype="float32")
                y = ptt.layers.scale(xv, scale=float(i))
            reused += id(main) in seen
            seen.add(id(main))
            got = exe.run(main, feed={"x": x}, fetch_list=[y.name])[0]
            np.testing.assert_array_equal(got, i * x)
            del main, xv, y
            gc.collect()    # free the program's cycles before the next
    assert reused  # the sweep did meet an id() that had been freed
    assert exe.cache_stats()["misses"] == 50


def test_validate_2_raises_through_run_and_run_stream(monkeypatch):
    """PADDLE_TPU_VALIDATE=2 through the executor (the JAX package's
    test_analysis.py executor wiring): a program with an op reading a
    var nothing makes fails every run, from the cached walk; a sound
    program walks once per version, run_stream included."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core.ir import OpDesc

    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "2")
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    feed = _feeds(np.random.RandomState(1), 1)[0]
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        before = analysis.walk_count()
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss])
        for h in exe.run_stream(main, iter([feed] * 4), fetch_list=[loss],
                                window=2):
            h.result()
        assert analysis.walk_count() == before + 1
        main.desc.block(0).ops.append(OpDesc(
            type="nosuch_op", inputs={"X": ["ghost"]},
            outputs={"Out": ["z"]}))
        main._bump_version()
        for _ in range(2):
            with pytest.raises(analysis.AnalysisError, match="ghost"):
                exe.run(main, feed=feed, fetch_list=[loss])
        assert analysis.walk_count() == before + 2


# -- the streaming trainer --------------------------------------------------------


class _DictDS:
    def __init__(self, feeds):
        self.feeds = feeds

    def _iter_batches(self):
        yield from self.feeds


def _train(pkg, window, feeds, monkeypatch, start=None):
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", str(window))
    main, startup, loss = _linreg_program(pkg)
    for op in main.global_block().ops:
        if op.type.startswith("dropout"):
            op.desc.attrs["is_test"] = True
    main._bump_version()
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        if start is not None:
            from paddle_tpu_torch.convert import scope_from_numpy

            scope_from_numpy(scope, start, ptt.CPUPlace())
        s0 = _state(scope, main)
        exe.train_from_dataset(main, _DictDS(feeds), fetch_list=[loss])
        return s0, _state(scope, main)


def test_trainer_streaming_equals_per_step(monkeypatch):
    feeds = _feeds(np.random.RandomState(13), 10)
    _, p_seq = _train(ptt, 1, feeds, monkeypatch)
    _, p_stream = _train(ptt, 4, feeds, monkeypatch)
    assert p_seq.keys() == p_stream.keys()
    for n in p_seq:
        np.testing.assert_array_equal(p_stream[n], p_seq[n], err_msg=n)


def test_trainer_streaming_matches_the_jax_package(monkeypatch):
    feeds = _feeds(np.random.RandomState(14), 10)
    s0, want = _train(pt, 4, feeds, monkeypatch)
    _, got = _train(ptt, 4, feeds, monkeypatch, start=s0)
    for n in want:
        np.testing.assert_allclose(
            got[n], want[n], rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want[n]).max())), err_msg=n)


def test_trainer_streaming_preempts_at_window_boundary(monkeypatch):
    feeds = _feeds(np.random.RandomState(17), 12)

    class _PreemptingDS:
        def _iter_batches(self):
            for i, f in enumerate(feeds):
                if i == 6:  # mid-window for window=4
                    preemption.request_stop("test")
                yield f

    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "4")
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    events.clear()
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        exe.train_from_dataset(main, _PreemptingDS(), fetch_list=[loss])
    summaries = [e for e in events.recent()
                 if e["kind"] == "step_summary"
                 and e.get("site") == "train_from_dataset"]
    assert summaries and summaries[-1]["stop"] == "preempted"
    assert summaries[-1]["steps"] == 6
    # the scope is that of 6 per-step runs
    preemption.reset()
    exe2 = ptt.Executor(ptt.CPUPlace())
    scope2 = ptt.Scope()
    with ptt.scope_guard(scope2):
        exe2.run(startup)
        for f in feeds[:6]:
            exe2.run(main, feed=f, fetch_list=[loss])
    a, b = _state(scope, main), _state(scope2, main)
    for n in b:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_trainer_fault_spec_forces_per_step(monkeypatch):
    from paddle_tpu_torch.trainer import _stream_window

    feeds = _feeds(np.random.RandomState(19), 8)
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "4")
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "step=3:error")
    assert _stream_window() == 1
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        with pytest.raises(faults.FaultInjected):
            exe.train_from_dataset(main, _DictDS(feeds), fetch_list=[loss])


def test_trainer_raise_level_numerics_forces_per_step(monkeypatch):
    from paddle_tpu_torch.trainer import _stream_window

    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "4")
    assert _stream_window() == 4
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "2")
    assert _stream_window() == 1
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    assert _stream_window() == 4

    feeds = _feeds(np.random.RandomState(29), 8)
    feeds[2]["x"][0, 0] = np.nan
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "2")
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        with pytest.raises(health.NumericsError):
            exe.train_from_dataset(main, _DictDS(feeds), fetch_list=[loss])


def test_trainer_telemetry_counts_steps_and_runs(monkeypatch):
    feeds = _feeds(np.random.RandomState(31), 6)
    s0 = telemetry.TRAINER_STEPS.value()
    _train(ptt, 4, feeds, monkeypatch)
    assert telemetry.TRAINER_STEPS.value() - s0 == 6


def test_infer_from_dataset_leaves_params(monkeypatch):
    """An inference program (no optimizer ops: `clone(for_test=True)`
    keeps a training program's, in both packages) streamed through
    infer_from_dataset leaves the params as they were."""
    feeds = _feeds(np.random.RandomState(37), 5)
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "2")
    main, startup, loss = _linreg_program(ptt, opt=None)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        params = [p.name for p in main.all_parameters()]
        before = {n: scope.get(n) for n in params}
        exe.infer_from_dataset(main, _DictDS(feeds), fetch_list=[loss])
        for n in params:
            np.testing.assert_array_equal(scope.get(n), before[n])


def test_multitrainer_streaming_converges(monkeypatch):
    from paddle_tpu_torch.trainer import train_from_dataset_multithread

    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "3")
    rng = np.random.RandomState(23)
    W = rng.rand(13, 1)
    main, startup, loss = _linreg_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())

    def factory(worker_id, num_workers):
        r = np.random.RandomState(100 + worker_id)

        def gen():
            for _ in range(12):
                X = r.rand(8, 13).astype("float32")
                yield {"x": X, "y": (X @ W).astype("float32")}
        return _DictDS(list(gen()))

    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        X = rng.rand(16, 13).astype("float32")
        probe = {"x": X, "y": (X @ W).astype("float32")}
        test_prog = main.clone(for_test=True)
        initial = float(exe.run(test_prog, feed=probe, fetch_list=[loss],
                                scope=scope)[0].reshape(()))
        steps = train_from_dataset_multithread(
            exe, main, factory, thread_num=2, fetch_list=[loss],
            scope=scope)
        assert steps == 24
        final = float(exe.run(test_prog, feed=probe, fetch_list=[loss],
                              scope=scope)[0].reshape(()))
    assert final < initial * 0.5


def test_train_from_dataset_with_a_dataloader(monkeypatch):
    """test_optimizer_extras.py's train-from-dataset test, fed by a
    DataLoader (the native datafeed is ROADMAP item 21): Adam over 8
    passes lowers the loss."""
    monkeypatch.setenv("PADDLE_TPU_STREAM_WINDOW", "4")
    rng = np.random.RandomState(41)
    W = rng.rand(4, 1)
    X = rng.rand(60, 4).astype("float32")
    Y = (X @ W).astype("float32")
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        y = ptt.layers.data(name="y", shape=[1], dtype="float32")
        pred = ptt.layers.fc(input=x, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(input=pred,
                                                            label=y))
        ptt.optimizer.Adam(0.05).minimize(loss)
        loader = ptt.DataLoader.from_generator(feed_list=[x, y],
                                               capacity=4)
    loader.set_sample_generator(lambda: iter(zip(X, Y)), batch_size=10)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        first = float(exe.run(main.clone(for_test=True),
                              feed={"x": X, "y": Y},
                              fetch_list=[loss])[0].reshape(()))
        for _ in range(8):
            exe.train_from_dataset(main, loader, fetch_list=[loss])
        last = float(exe.run(main.clone(for_test=True),
                             feed={"x": X, "y": Y},
                             fetch_list=[loss])[0].reshape(()))
    assert last < first * 0.2, (first, last)
    assert _wait_no_prefetch_threads()


# -- readers, DataFeeder, reader decorators, metrics ------------------------------


def _feed_vars(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        img = pkg.layers.data(name="img", shape=[2, 3], dtype="float32")
        lab = pkg.layers.data(name="label", shape=[1], dtype="int64")
    return [img, lab]


def _samples(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(2, 3).astype("float64"), int(rng.randint(0, 9)))
            for _ in range(n)]


def test_data_feeder_matches_jax():
    samples = _samples()
    got = ptt.DataFeeder(_feed_vars(ptt)).feed(samples)
    want = pt.DataFeeder(_feed_vars(pt)).feed(samples)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("how", ["sample", "sample_list", "batch",
                                 "pyreader"])
def test_generator_loader_batches_match_jax(how):
    """Each way of feeding a loader yields the JAX package's batches."""
    samples = _samples(9, seed=1)
    out = {}
    for pkg in (pt, ptt):
        fv = _feed_vars(pkg)
        if how == "pyreader":
            loader = pkg.reader.PyReader(feed_list=fv, capacity=4)
            loader.decorate_sample_generator(lambda: iter(samples),
                                             batch_size=4, drop_last=False)
        else:
            loader = pkg.DataLoader.from_generator(feed_list=fv,
                                                   capacity=4)
            if how == "sample":
                loader.set_sample_generator(lambda: iter(samples),
                                            batch_size=4)
            elif how == "sample_list":
                loader.set_sample_list_generator(
                    lambda: iter([samples[:3], samples[3:]]))
            else:
                loader.set_batch_generator(lambda: iter(
                    [(np.stack([s[0] for s in samples[i:i + 3]]),
                      np.array([[s[1]] for s in samples[i:i + 3]]))
                     for i in (0, 3, 6)]))
        out[pkg.__name__] = list(loader())
    got, want = out["paddle_tpu_torch"], out["paddle_tpu"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
    assert _wait_no_prefetch_threads()


def test_dataset_loader_matches_jax():
    feeds = _feeds(np.random.RandomState(43), 5)
    for double in (False, True):
        got = list(ptt.DataLoader.from_dataset(
            _DictDS(feeds), places=[ptt.CPUPlace()],
            use_double_buffer=double))
        want = list(pt.DataLoader.from_dataset(
            _DictDS(feeds), places=[pt.CPUPlace()],
            use_double_buffer=double))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    assert _wait_no_prefetch_threads()


def test_elastic_shard_plan_matches_jax():
    a = ptt.reader.ElasticShardPlan(50, 12, seed=3)
    b = pt.reader.ElasticShardPlan(50, 12, seed=3)
    for step in (0, 3, 7):
        for w in (1, 3, 5):
            for r in range(w):
                np.testing.assert_array_equal(a.worker_indices(step, r, w),
                                              b.worker_indices(step, r, w))


@pytest.mark.parametrize("name", ["batch", "shuffle", "buffered",
                                  "firstn", "chain", "compose",
                                  "map_readers", "xmap_readers", "cache"])
def test_reader_decorators_match_jax(name):
    import random

    def reader():
        return iter(range(23))

    def apply(mod):
        d = {"batch": lambda: mod.batch(reader, 5),
             "shuffle": lambda: mod.shuffle(reader, 7),
             "buffered": lambda: mod.buffered(reader, 3),
             "firstn": lambda: mod.firstn(reader, 9),
             "chain": lambda: mod.chain(reader, reader),
             "compose": lambda: mod.compose(reader, reader),
             "map_readers": lambda: mod.map_readers(lambda a, b: a * b,
                                                    reader, reader),
             "xmap_readers": lambda: mod.xmap_readers(
                 lambda a: a + 1, reader, 2, 4, order=True),
             "cache": lambda: mod.cache(reader)}[name]()
        random.seed(5)
        return list(d())

    assert apply(ptt.reader_decorators) == apply(pt.reader_decorators)


def test_metrics_match_jax():
    """metrics.py (numpy only, copied) on the same batches: Accuracy
    (test_book.py's case), Precision, Recall, ChunkEvaluator and
    EditDistance."""
    m = ptt.metrics.Accuracy()
    m.update(value=0.5, weight=10)
    m.update(value=1.0, weight=10)
    assert abs(m.eval() - 0.75) < 1e-6
    rng = np.random.RandomState(47)
    preds = rng.rand(40, 1).astype("float32")
    labels = rng.randint(0, 2, (40, 1)).astype("int64")
    for cls in ("Precision", "Recall"):
        a, b = getattr(ptt.metrics, cls)(), getattr(pt.metrics, cls)()
        for i in (0, 20):
            a.update(preds[i:i + 20], labels[i:i + 20])
            b.update(preds[i:i + 20], labels[i:i + 20])
        assert a.eval() == b.eval()
    a, b = ptt.metrics.ChunkEvaluator(), pt.metrics.ChunkEvaluator()
    for m_ in (a, b):
        m_.update(10, 8, 6)
        m_.update(4, 5, 3)
    assert a.eval() == b.eval()
    a, b = ptt.metrics.EditDistance("ed"), pt.metrics.EditDistance("ed")
    for m_ in (a, b):
        m_.update(np.array([[1.0], [0.0], [3.0]]), 3)
    assert a.eval() == b.eval()
